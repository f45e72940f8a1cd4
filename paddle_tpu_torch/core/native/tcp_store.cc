// TCPStore server: the rendezvous / coordination KV store.
//
// Parity: `paddle/phi/core/distributed/store/tcp_store.h:121` and
// `tcp_utils.h` (Command enum {ADD, GET, CHECK, SET, WAIT, STOP}).
// Re-designed, not translated: one poll()-driven event loop, no thread per
// client, WAIT parking implemented as a per-key list of parked sockets that
// are answered on the SET/ADD that materialises the key.
//
// Wire protocol (all integers little-endian):
//   request : u8 cmd | u32 klen | klen bytes key | u64 vlen | vlen bytes val
//   ADD     : val is ascii i64 delta; reply u64 len + ascii new value
//   GET     : reply u64 len + bytes (parks until key exists)
//   CHECK   : reply u8 (1 ready / 0 missing)
//   SET     : reply u8 1
//   WAIT    : reply u8 1 (parks until key exists)
//   STOP    : shuts the server down
//
// Exposed as a C ABI for ctypes:
//   int  pts_start(int port)      -> listening fd key (>=0) or -errno
//   int  pts_port(int handle)     -> bound port (for port 0 auto-assign)
//   void pts_stop(int handle)
//
// Build: g++ -O2 -shared -fPIC -o libpts.so tcp_store.cc -lpthread

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/socket.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

enum Cmd : uint8_t { ADD = 0, GET = 1, CHECK = 2, SET = 3, WAIT = 4,
                     STOP = 5, DEL = 6 };

struct Server {
  int listen_fd = -1;
  int port = 0;
  std::atomic<bool> running{false};
  std::thread loop;
  std::unordered_map<std::string, std::vector<uint8_t>> store;
  std::unordered_map<std::string, std::vector<int>> parked;  // WAIT/GET fds
  std::unordered_map<std::string, std::vector<int>> parked_get;
};

std::mutex g_mu;
std::map<int, Server*> g_servers;
int g_next = 1;

bool send_all(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t k = ::send(fd, p, n, MSG_NOSIGNAL);
    if (k <= 0) return false;
    p += k;
    n -= static_cast<size_t>(k);
  }
  return true;
}

bool recv_all(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t k = ::recv(fd, p, n, 0);
    if (k <= 0) return false;
    p += k;
    n -= static_cast<size_t>(k);
  }
  return true;
}

bool reply_value(int fd, const std::vector<uint8_t>& v) {
  uint64_t len = v.size();
  if (!send_all(fd, &len, 8)) return false;
  return v.empty() || send_all(fd, v.data(), v.size());
}

bool reply_byte(int fd, uint8_t b) { return send_all(fd, &b, 1); }

void answer_parked(Server* s, const std::string& key) {
  auto it = s->parked.find(key);
  if (it != s->parked.end()) {
    for (int fd : it->second) reply_byte(fd, 1);
    s->parked.erase(it);
  }
  auto ig = s->parked_get.find(key);
  if (ig != s->parked_get.end()) {
    for (int fd : ig->second) reply_value(fd, s->store[key]);
    s->parked_get.erase(ig);
  }
}

// returns false when the client socket must be closed
bool handle_one(Server* s, int fd) {
  uint8_t cmd;
  if (!recv_all(fd, &cmd, 1)) return false;
  uint32_t klen;
  if (!recv_all(fd, &klen, 4) || klen > (1u << 20)) return false;
  std::string key(klen, '\0');
  if (klen && !recv_all(fd, &key[0], klen)) return false;
  uint64_t vlen;
  if (!recv_all(fd, &vlen, 8) || vlen > (1ull << 32)) return false;
  std::vector<uint8_t> val(vlen);
  if (vlen && !recv_all(fd, val.data(), vlen)) return false;

  switch (cmd) {
    case ADD: {
      int64_t delta = 0, cur = 0;
      delta = strtoll(std::string(val.begin(), val.end()).c_str(), nullptr,
                      10);
      auto& slot = s->store[key];
      if (!slot.empty())
        cur = strtoll(std::string(slot.begin(), slot.end()).c_str(), nullptr,
                      10);
      cur += delta;
      std::string out = std::to_string(cur);
      slot.assign(out.begin(), out.end());
      answer_parked(s, key);
      return reply_value(fd, slot);
    }
    case SET: {
      s->store[key] = std::move(val);
      answer_parked(s, key);
      return reply_byte(fd, 1);
    }
    case CHECK:
      return reply_byte(fd, s->store.count(key) ? 1 : 0);
    case DEL:
      s->store.erase(key);
      return reply_byte(fd, 1);
    case GET: {
      auto it = s->store.find(key);
      if (it != s->store.end()) return reply_value(fd, it->second);
      s->parked_get[key].push_back(fd);  // answered on SET/ADD
      return true;
    }
    case WAIT: {
      if (s->store.count(key)) return reply_byte(fd, 1);
      s->parked[key].push_back(fd);
      return true;
    }
    case STOP:
      s->running = false;
      reply_byte(fd, 1);
      return false;
    default:
      return false;
  }
}

void unpark_fd(Server* s, int fd) {
  for (auto* m : {&s->parked, &s->parked_get})
    for (auto& kv : *m) {
      auto& v = kv.second;
      v.erase(std::remove(v.begin(), v.end(), fd), v.end());
    }
}

void run_loop(Server* s) {
  std::vector<struct pollfd> fds;
  fds.push_back({s->listen_fd, POLLIN, 0});
  while (s->running) {
    int n = ::poll(fds.data(), fds.size(), 200 /*ms*/);
    if (n < 0) break;
    if (n == 0) continue;
    std::vector<int> to_close;
    size_t nfds = fds.size();
    for (size_t i = 0; i < nfds; ++i) {
      if (!(fds[i].revents & (POLLIN | POLLHUP | POLLERR))) continue;
      if (fds[i].fd == s->listen_fd) {
        int c = ::accept(s->listen_fd, nullptr, nullptr);
        if (c >= 0) {
          int one = 1;
          setsockopt(c, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
          // bound how long a half-sent request from a hung client can
          // stall the single-threaded loop (control-plane messages are
          // small; 5s covers a multi-MB p2p payload on any real link)
          struct timeval tv{5, 0};
          setsockopt(c, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
          fds.push_back({c, POLLIN, 0});
        }
      } else if (!handle_one(s, fds[i].fd)) {
        to_close.push_back(fds[i].fd);
      }
    }
    for (int fd : to_close) {
      unpark_fd(s, fd);
      ::close(fd);
      for (size_t i = 0; i < fds.size(); ++i)
        if (fds[i].fd == fd) {
          fds.erase(fds.begin() + i);
          break;
        }
    }
  }
  for (auto& p : fds)
    if (p.fd != s->listen_fd) ::close(p.fd);
  ::close(s->listen_fd);
}

}  // namespace

extern "C" {

int pts_start(int port) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0 ||
      ::listen(fd, 128) < 0) {
    ::close(fd);
    return -2;
  }
  socklen_t len = sizeof(addr);
  ::getsockname(fd, reinterpret_cast<sockaddr*>(&addr), &len);

  auto* s = new Server();
  s->listen_fd = fd;
  s->port = ntohs(addr.sin_port);
  s->running = true;
  s->loop = std::thread(run_loop, s);

  std::lock_guard<std::mutex> g(g_mu);
  int h = g_next++;
  g_servers[h] = s;
  return h;
}

int pts_port(int handle) {
  std::lock_guard<std::mutex> g(g_mu);
  auto it = g_servers.find(handle);
  return it == g_servers.end() ? -1 : it->second->port;
}

void pts_stop(int handle) {
  Server* s = nullptr;
  {
    std::lock_guard<std::mutex> g(g_mu);
    auto it = g_servers.find(handle);
    if (it == g_servers.end()) return;
    s = it->second;
    g_servers.erase(it);
  }
  s->running = false;
  if (s->loop.joinable()) s->loop.join();
  delete s;
}

}  // extern "C"
